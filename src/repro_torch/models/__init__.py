"""The LM stack on torch tensors: building blocks, attention, the decoder
and the model factory."""
