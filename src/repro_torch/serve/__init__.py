"""Paged continuous-batching serving of the port."""
from .engine import AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine  # noqa: F401
from .paged_cache import PageAllocator, PagedKVCache  # noqa: F401
from .scheduler import RequestState, Scheduler, SchedulerConfig  # noqa: F401
