from repro_torch.serve.engine import Engine, EngineConfig  # noqa: F401
from repro_torch.serve.kvcache import Sequence, SlotAllocator  # noqa: F401
