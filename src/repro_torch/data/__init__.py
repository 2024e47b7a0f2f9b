from repro_torch.data.pipeline import SyntheticPipeline, shapes_for_cell  # noqa: F401
