"""The encoders (Swin-T, ResNet-18) and the transformer decoder of the
port."""
