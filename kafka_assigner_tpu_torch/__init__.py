"""kafka_assigner_tpu_torch — the PyTorch/CUDA port of ``kafka_assigner_tpu``.

The JAX package beside it is the reference; this package mirrors its layout
so each module's counterpart sits at the same path, and its output is held
byte-identical to the reference's ``--solver tpu`` path.

What this package covers today is every mode of the reference CLI, mode 3
on each of the reference's solver lanes:

- ``models.problem``       — host encode/decode, through the C boundary
  codec or its numpy twin;
- ``native``               — the port's own copies of the reference's C
  codec and C++ greedy / host leadership pass, built with gcc/g++;
- ``ops.assignment``       — placement in plain PyTorch, batched over topics
  (sticky fill, then the fast → dense → balance → seq leg chain), with a
  liveness mask per row, and the what-if sweeps built on it;
- ``ops.leadership``       — leadership ordering: a hand-written Hopper
  kernel (``csrc/leadership.cu``) and its plain PyTorch twin;
- ``solvers``              — ``TorchSolver`` (the ``TpuSolver`` counterpart,
  ``--solver device``), the C++ greedy (``native``) and the Python oracle
  (``greedy``);
- ``parallel.whatif``      — batched broker-removal what-if sweeps;
- ``obs``                  — spans, metrics, the schema-v1 run report and
  the ``torch.profiler`` hook;
- ``faults``               — deterministic fault injection; with the
  ``--failure-policy`` of ``assigner`` and ``cli``, the best-effort lane;
- ``exec``                 — plan execution (``ka-execute``): journaled,
  throttled waves, resume, rollback and a verify pass, no device work;
- ``assigner`` / ``generator`` / ``cli`` — the CLI surface.

It imports ``torch`` and numpy, never ``jax`` and nothing of
``kafka_assigner_tpu``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
