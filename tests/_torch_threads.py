"""The one-thread fixture of the port's slow CPU tests.

Under ``-p xdist -n 6`` every worker starts with a thread pool as wide as
the host, and the workers share its cores.  Small torch ops then slow down
by up to two orders of magnitude: the LM example's 60 steps take 7 s alone
and 882 s so, jamba's two training steps 12 s alone and over 900 s so.  A
wall-clock check (the straggler watchdog's 2.5x the median step) also
jitters past its threshold with a full pool.  One thread a test keeps each
of them near its time alone.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture
def one_thread():
    """One intra-op thread for the test, the caller's count restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
