"""The reference's three examples on the port, one module each, run as
``python -m repro_torch.examples.<name>``:

- ``serve_lm``: the continuous-batching decode engine over batched
  requests (``examples/serve_lm.py``);
- ``train_lm``: training with checkpoint and restart, optionally as an
  ExpoCloud task that resumes after a failure (``examples/train_lm.py``);
- ``quickstart``: a sweep, a short training run and a dry-run cell
  (``examples/quickstart.py``).

Each runs on the card unless the caller passes ``--device cpu``.
"""
