from repro_torch.data.synthetic import SyntheticLM, label_flip

__all__ = ["SyntheticLM", "label_flip"]
