"""Train stack of the port (port of ``repro/train``)."""
from .loss import cross_entropy, make_loss_fn
from .sharding import Distribution, make_distribution
from .step import TrainStepBundle, init_train_state, make_train_step_bundle
from .trainer import Trainer

__all__ = ["cross_entropy", "make_loss_fn", "Distribution",
           "make_distribution", "TrainStepBundle",
           "init_train_state", "make_train_step_bundle", "Trainer"]
