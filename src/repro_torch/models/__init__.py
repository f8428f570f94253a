from repro_torch.models.transformer import (Transformer, forward_train,
                                            init_params, loss_fn, torch_dtype)

__all__ = ["Transformer", "init_params", "forward_train", "loss_fn",
           "torch_dtype"]
