"""Training: L1 + D-SSIM loss, the 3DGS step and optimizer, density control,
checkpoints and the training CLI."""
