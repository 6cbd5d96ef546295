"""tools of the PyTorch port: model export, quality evaluation, and an A/B
of two builds of the flash-attention backward on the card."""
