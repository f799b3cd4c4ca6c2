"""Architecture registry of the port."""
from .base import ArchConfig, all_archs, get_arch, register  # noqa: F401
from .archs import ASSIGNED  # noqa: F401,E402
