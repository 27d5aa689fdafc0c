"""Weights in and out of the port: ``convert`` turns the reference's θ,
training state and LLM parameters into the port's. The npz checkpoint
io lands with a later slice."""
