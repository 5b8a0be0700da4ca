from .array_store import ArrayStore
from .map_runner import CachedMap, MapInfra
from .task_cache import TaskInfra
