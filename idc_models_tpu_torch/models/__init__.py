"""Models: the layer library, MobileNetV2, the registry, weight import."""
