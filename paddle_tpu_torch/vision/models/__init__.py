from .vit import VisionTransformer, vit_b_16, vit_l_16

__all__ = ["VisionTransformer", "vit_b_16", "vit_l_16"]
