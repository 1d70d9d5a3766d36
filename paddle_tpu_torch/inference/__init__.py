from .paged import (AdmissionRejected, EngineStalledError, PageDoubleFreeError,
                    PagePool, PoolCapacityError, PrefixCache, Request,
                    ServingEngine, prefix_chain_hashes, serve_requests)

__all__ = ["AdmissionRejected", "EngineStalledError", "PageDoubleFreeError",
           "PagePool", "PoolCapacityError", "PrefixCache", "Request",
           "ServingEngine", "prefix_chain_hashes", "serve_requests"]
