"""The training path: the GAN loss, the phases and the loop."""
