"""kafka_assigner_tpu_torch — the PyTorch/CUDA port of ``kafka_assigner_tpu``.

The JAX package beside it is the reference; this package mirrors its layout
so each module's counterpart sits at the same path, and its output is held
byte-identical to the reference's ``--solver tpu`` path.

What this package covers today is mode 3 (``PRINT_REASSIGNMENT``) on the
device solver:

- ``models.problem``       — host encode/decode (numpy), a copy of the
  reference's numpy path;
- ``ops.assignment``       — placement in plain PyTorch, batched over topics
  (sticky fill, then the fast → dense → balance → seq leg chain);
- ``ops.leadership``       — leadership ordering: a hand-written Hopper
  kernel (``csrc/leadership.cu``) and its plain PyTorch twin;
- ``solvers.torch_solver`` — ``TorchSolver``, the ``TpuSolver`` counterpart;
- ``assigner`` / ``generator`` / ``cli`` — the mode-3 surface.

It imports ``torch`` and numpy, never ``jax`` and nothing of
``kafka_assigner_tpu``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
