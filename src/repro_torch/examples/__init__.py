"""The port's runnable examples, each a module with a ``main()``:
``python -m repro_torch.examples.<name>`` with ``src`` on the path."""
