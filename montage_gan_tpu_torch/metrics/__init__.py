# Distribution and perceptual metrics of the port (FID, KID, IS, PR, PPL).
