"""Device milliseconds a step of the optimizer: the device operations
launched inside ``torch.optim``'s own ``Optimizer.step#...`` span, read
from the traced run's profile."""


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    return rec.trace.device_ms(lambda name: name.startswith("Optimizer.step#"))
