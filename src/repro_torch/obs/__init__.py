"""Step-build counters (see :mod:`repro_torch.obs.counters`)."""
