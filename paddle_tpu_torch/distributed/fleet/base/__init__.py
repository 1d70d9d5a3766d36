"""fleet.base (port of ``paddle_tpu/distributed/fleet/base``)."""
