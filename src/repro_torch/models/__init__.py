"""The LM substrate (the JAX package's ``models/``, on torch ``nn.Module``s):
config, layers, MoE, SSMs and the FFT long-convolution mixer, the
transformer stack, analytic costs and the weight converter."""
