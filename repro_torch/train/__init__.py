"""The LM training substrate (``repro.train``' counterpart): the
step-indexed synthetic data, AdamW, the loss and the train step, and
the curation driver (``curated``).  ``__all__`` is the JAX package's
``repro.train.__all__``; the cross-pod compressed step is
``train.compressed``, imported explicitly as in the JAX package.  The
train driver, on one card or a mesh of several, is
``launch.train``."""

from .data import DataConfig, DataPipeline, synthetic_batch
from .optimizer import OptConfig, apply_updates, init_opt_state
from .train_step import lm_loss, loss_fn, make_eval_step, make_train_step

__all__ = ["DataConfig", "DataPipeline", "synthetic_batch", "OptConfig",
           "apply_updates", "init_opt_state", "lm_loss", "loss_fn",
           "make_eval_step", "make_train_step"]
