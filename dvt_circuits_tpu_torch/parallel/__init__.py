"""The sharded prover on ``torch.distributed``: one process a card, the
counterpart of ``dvt_circuits_tpu/parallel``."""

from .mesh import Mesh, spawn
