from repro_torch.train.step import (
    TrainState, make_prefill_step, make_serve_step, make_train_step,
)
from repro_torch.train.loop import fit
