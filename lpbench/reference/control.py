"""The control: the reference put in the program's place, one precision
below the f32 the configurations state. The reference's answer is the
PageRank vector from the power iteration with y = 0
(reference/pagerank.py); the control stores S and x in bfloat16 for
each product and adds in f32, as a solver that moved its matrix and
vectors to bfloat16 would. `python3 lpbench/control.py` runs it at a
cell's size on the chip.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lp import Lp
from . import pagerank


def answer(lp: Lp, damping: float, dtype=torch.bfloat16, device="cpu"):
    """The control's answer (x, y) to `lp`."""
    x = pagerank.power_iteration(pagerank.transition(lp, damping), damping,
                                 dtype, device)
    return x, np.zeros(lp.shape[0])
