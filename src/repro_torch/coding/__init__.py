from repro_torch.coding import gf256, linear, lrc, rs, spc
from repro_torch.coding.linear import LinearCode
from repro_torch.coding.lrc import LRC, make_lrc
from repro_torch.coding.rs import make_rs
from repro_torch.coding.spc import make_spc

__all__ = [
    "gf256",
    "linear",
    "lrc",
    "rs",
    "spc",
    "LinearCode",
    "LRC",
    "make_lrc",
    "make_rs",
    "make_spc",
]
