from repro_torch.train.step import make_prefill_step, make_serve_step
