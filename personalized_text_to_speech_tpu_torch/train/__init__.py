"""Training of the port: losses, optimizers, the fused GAN step, the Trainer."""
