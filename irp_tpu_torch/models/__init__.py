"""ResNet + MLP-head classifier and weight conversion."""
