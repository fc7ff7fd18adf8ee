"""GaussianModel."""
