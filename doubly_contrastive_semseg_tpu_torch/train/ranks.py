"""What the trainers do differently with several ranks (``parallel/``):
rank 0 alone writes the run directory, the log file, the summaries and the
checkpoints, and every rank stops after the same finished step once a
signal reached any of them or the launcher. With one rank each function is
the one-process behaviour."""

from __future__ import annotations

import logging
import signal

from .. import parallel
from ..utils import Saver, SummaryWriter, setup_logger
from ..utils.summaries import NullSummaryWriter


def make_saver(cfg) -> Saver:
    """Rank 0's new run directory; on the other ranks a ``Saver`` of the
    same directory that writes nothing."""
    if parallel.world().rank == 0:
        saver = Saver(cfg)
        parallel.broadcast_object(saver.experiment_dir)
        return saver
    return Saver(cfg, parallel.broadcast_object(None), write=False)


def setup_run_logger(saver: Saver, name_prefix: str) -> None:
    """The run's log file on rank 0; warnings alone on the console of the
    other ranks."""
    if saver.write:
        setup_logger(saver.experiment_dir, name_prefix)
    else:
        setup_logger(None)
        logging.getLogger().setLevel(logging.WARNING)


def make_writer(saver: Saver, enable_tb: bool):
    return SummaryWriter(saver.experiment_dir, enable_tb=enable_tb) if saver.write \
        else NullSummaryWriter()


class SignalStop:
    """With several ranks, SIGTERM/SIGINT to a rank only records the signal
    (``signum``); ``agreed()`` at the end of a step tells every rank the
    same signal, or 0: the largest of the ranks' and the launcher's."""

    def __init__(self):
        self.signum = 0
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, self._record)
            except ValueError:   # not the main thread
                return

    def _record(self, signum, frame) -> None:
        self.signum = signum

    def agreed(self) -> int:
        stop = parallel.world().stop
        return parallel.agree_max(max(self.signum, stop.value if stop is not None else 0))
