from repro_torch.serve.kvcache import Request, SlotManager, plan_for  # noqa: F401
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step  # noqa: F401
