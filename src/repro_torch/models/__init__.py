"""Models: ResNet-20, and the LM zoo's dense and ssm decoders (``registry``)."""
