from .builder import ModelBuilder  # noqa: F401
from .resnet import PoseResNet  # noqa: F401
