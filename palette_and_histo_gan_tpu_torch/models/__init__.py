"""The networks and their weights: the U-Net generator and the PatchGAN
discriminator (`networks`), the Flax weight bridge (`convert`), the FID's
InceptionV3 (`inception`) and the serving export (`export`).

The package imports none of them, so that a serving process can load an
exported program (`export.load_exported`) without the model code.
"""
