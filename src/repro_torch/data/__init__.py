from repro_torch.data.pipeline import SyntheticPipeline, batch_for_shape
