from repro_torch.analysis.roofline import Roofline, analyze_compiled, analyze_hlo  # noqa: F401
