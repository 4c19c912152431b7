"""Built-in hex model families of the PyTorch port."""
from .hexcnn import HexCNN, hexcnn_small, hexcnn_tiny
from .train import hexify_batch

__all__ = ["HexCNN", "hexcnn_small", "hexcnn_tiny", "hexify_batch"]
