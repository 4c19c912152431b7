"""Built-in hex model families and training utilities of the PyTorch port."""
from .deeplab import HexDeepLabV3
from .fit import fit
from .hexcnn import (HexCNN, HexConvNeXtBlock, HexResBlock, HexResNet,
                     hexcnn_small, hexcnn_tiny)
from .hexunet import HexConvTranspose2d, HexPixelShuffleUpsample, HexUNet
from .hexvit import HexViT, hexvit_tiny
from .train import (TrainState, create_train_state, dense_onehot_xent,
                    eval_step, hexify_batch, mean_iou, synthetic_hex_cifar,
                    synthetic_hex_shapes, train_step)
from .video import (StreamStats, make_batch_processor, make_frame_processor,
                    process_stream)

__all__ = ["HexCNN", "hexcnn_small", "hexcnn_tiny", "HexConvNeXtBlock",
           "HexResBlock", "HexResNet", "HexViT", "hexvit_tiny", "HexUNet",
           "HexConvTranspose2d", "HexPixelShuffleUpsample", "HexDeepLabV3",
           "fit", "TrainState",
           "create_train_state", "train_step", "eval_step",
           "dense_onehot_xent", "hexify_batch", "synthetic_hex_cifar",
           "synthetic_hex_shapes", "mean_iou", "make_frame_processor",
           "make_batch_processor", "process_stream", "StreamStats"]
