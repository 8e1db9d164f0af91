from repro_torch.data.pipeline import DataConfig, TokenPipeline, calibration_stream  # noqa: F401
