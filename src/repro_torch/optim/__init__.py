"""Optimizer, schedules and gradient compression — twins of :mod:`repro.optim`."""
from repro_torch.optim.adamw import AdamW, AdamWConfig  # noqa: F401
from repro_torch.optim.schedule import constant_schedule, cosine_schedule  # noqa: F401
