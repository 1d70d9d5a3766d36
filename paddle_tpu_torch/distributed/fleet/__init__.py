"""Fleet orchestration of the port (reference:
python/paddle/distributed/fleet/).  So far the elastic membership manager
(:mod:`.elastic`); the hybrid-parallel API is not ported yet."""
