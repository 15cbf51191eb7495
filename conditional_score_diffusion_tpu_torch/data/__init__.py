"""Host data: the texture160 / CelebA-160 test split and its SR degradation."""
