"""Model components."""
from .blocks import (Basic3DBlock, Hourglass, Pool3DBlock, Res3DBlock,
                     Upsample3DBlock)
from .detector import KyptDetector, KyptToVoxNet, VoxToKyptNet
from .dynamics import HSVRNNBVH, SkeletonArrays
from .marionette import NeuralMarionette

__all__ = ["Basic3DBlock", "Hourglass", "Pool3DBlock", "Res3DBlock",
           "Upsample3DBlock", "KyptDetector", "KyptToVoxNet", "VoxToKyptNet",
           "HSVRNNBVH", "SkeletonArrays", "NeuralMarionette"]
