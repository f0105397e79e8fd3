from .loop import TrainResult, make_train_step, train_node_classifier
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["TrainResult", "train_node_classifier", "make_train_step",
           "save_checkpoint", "restore_checkpoint", "latest_step"]
