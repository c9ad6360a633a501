"""Multi-device solves. For now only the zero padding that heterogeneous
fleets (batch.solve_batch) share with the JAX package's sharded solves."""

from .sharded import pad_problem

__all__ = ["pad_problem"]
