"""tools of the PyTorch port: model export and quality evaluation."""
