"""The paper's four edge networks (SqueezeNet1.1, MobileNetV3-Small,
ResNet18, MobileViT-xxs) as accelerator layer graphs."""

from repro_torch.models.edge_cnn import EDGE_NETWORKS, edge_network

__all__ = ["EDGE_NETWORKS", "edge_network"]
