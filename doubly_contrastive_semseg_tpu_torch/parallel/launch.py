"""Starting the ranks of ``--num_devices`` N (N > 1): ``check_devices``
refuses what the machine cannot run, ``spawn_ranks`` starts N processes
with ``torch.multiprocessing`` and a loopback TCP rendezvous (no network),
and turns SIGTERM/SIGINT into a shared stop flag that the ranks read at the
end of each step (``train/trainer.py``: every rank stops after the same
finished step and rank 0 writes the rescue checkpoint).
"""

from __future__ import annotations

import math
import signal
import socket
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.multiprocessing as mp
from torch.multiprocessing import ProcessExitedException

STOP_SIGNALS = (signal.SIGTERM, signal.SIGINT)
# seconds a rank is given to exit after another has failed
GRACE_S = 5.0


def check_devices(cfg, shape: Optional[Sequence[int]] = None) -> None:
    """``ValueError`` for a ``--num_devices`` N > 1 the run cannot have:
    fewer visible GPUs than N on ``cuda`` (JAX's ``make_mesh`` would take
    the devices it finds; the port refuses rather than run on fewer), or,
    in training, a train batch of fewer than N samples. ``shape``, a
    ``('data', 'model')`` grid (d, m) of ``make_mesh``, counts d·m ranks,
    of which the batch is split over the d of the data axis."""
    n = math.prod(shape) if shape else (cfg.num_devices or 1)
    if n <= 1:
        return
    if cfg.device == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"--num_devices {n} needs {n} GPUs; {torch.cuda.device_count()} "
                         "visible")
    d = shape[0] if shape else n
    if not cfg.test_only and cfg.batch_size < d:
        raise ValueError(f"--num_devices {n}: a train batch of {cfg.batch_size} samples leaves "
                         "a rank without one")


def free_init_method() -> str:
    """A ``tcp://127.0.0.1:<port>`` rendezvous on a port that was free."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def spawn_ranks(fn: Callable, n: int, args: Tuple = ()) -> None:
    """Runs ``fn(rank, n, init_method, stop, *args)`` in ``n`` spawned
    processes and waits for them. ``stop`` is a shared int: SIGTERM or
    SIGINT to this process stores the signal's number there. A rank that
    fails stops the others and raises here; ranks that stopped on the
    signal make this process raise ``SystemExit(128 + signum)``, as one
    process would; ranks that finished first end it normally."""
    ctx = mp.get_context("spawn")
    stop = ctx.Value("i", 0)

    def on_signal(signum, frame):
        stop.value = signum

    old = {}
    for sig in STOP_SIGNALS:
        try:
            old[sig] = signal.signal(sig, on_signal)
        except ValueError:   # not the main thread
            break
    try:
        pc = mp.start_processes(fn, args=(n, free_init_method(), stop) + tuple(args),
                                nprocs=n, join=False, start_method="spawn")
        while not pc.join(grace_period=GRACE_S):
            pass
    except ProcessExitedException as e:
        if stop.value and e.exit_code == 128 + stop.value:
            raise SystemExit(e.exit_code) from None
        raise
    finally:
        for sig, h in old.items():
            signal.signal(sig, h)
