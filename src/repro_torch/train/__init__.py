from repro_torch.train.optimizer import adamw_init, adamw_update, OptConfig
from repro_torch.train.trainer import make_train_step, loss_fn
