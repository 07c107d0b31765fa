"""The plain reference: the flagship's mathematics in float32 PyTorch, with
no kernel, cache or batching of the port and nothing imported from it.

``transform`` (the KBD-windowed MDCT as a framed matrix product, the
arcsinh normalisation, the polyphase resample and the degrade), ``models``
(the LocalEnhancer / GlobalGenerator with the BottleStack attention, the
multiscale PatchGAN), ``train`` (the GAN losses, one step's gradients and
Adam) and ``serve`` (segment, generate, synthesise, stitch).  They are a
frozen copy of the port's plain code as it stood when the benchmark was
written.  ``precision`` holds the control's lower precision: every
convolution's operands rounded to float8 e4m3.
"""
