"""Paged continuous-batching serving of the port, with routing over cubes
(``CubeRouter`` in process, ``CubeProcRouter`` over one worker process per
cube) and the dense fixed-slot reference engine (``DenseSlotEngine``)."""
from .admission import AdmissionPipeline  # noqa: F401
from .cube_proc import CubeProc, CubeProcRouter  # noqa: F401
from .dense_engine import DenseSlotEngine  # noqa: F401
from .engine import (  # noqa: F401
    AdmissionConfig, CacheConfig, EngineConfig, ObsConfig, Request, ServeEngine, sample_tokens)
from .host_tier import HostPagePool, SwapHandle  # noqa: F401
from .paged_cache import PageAllocator, PagedKVCache, PrefixClaim, PrefixIndex  # noqa: F401
from .router import CubeRouter  # noqa: F401
from .scheduler import RequestState, Scheduler, SchedulerConfig  # noqa: F401
