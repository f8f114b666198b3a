from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator  # noqa: F401
