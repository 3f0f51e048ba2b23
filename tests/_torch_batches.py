"""Batches by frontend for the port's tests, built from the port's
``Model.input_specs``: numpy arrays with its keys and shapes, drawn in its
order (int32 tokens and labels uniform over the vocabulary, frames and
patches normal in f32), so the same arrays feed the JAX model and the
port.  Imports no JAX: the tests on the card use it too."""

import numpy as np
import torch

from repro_torch.configs.shapes import Shape


def numpy_batch(model, B, S, seed):
    """A train batch (labels included) of S positions for ``model`` from
    ``default_rng(seed)``."""
    specs = model.input_specs(Shape("test", S, B, "train"))["batch"]
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, model.cfg.vocab_size, m.shape).astype(np.int32)
            if m.dtype == torch.int32 else
            rng.normal(size=m.shape).astype(np.float32)
            for k, m in specs.items()}
