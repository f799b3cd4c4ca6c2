"""Paged continuous-batching serving of the port."""
from .admission import AdmissionPipeline  # noqa: F401
from .engine import (  # noqa: F401
    AdmissionConfig, CacheConfig, EngineConfig, ObsConfig, Request, ServeEngine, sample_tokens)
from .host_tier import HostPagePool, SwapHandle  # noqa: F401
from .paged_cache import PageAllocator, PagedKVCache, PrefixClaim, PrefixIndex  # noqa: F401
from .scheduler import RequestState, Scheduler, SchedulerConfig  # noqa: F401
