"""Weights in and out of the port: ``convert`` turns the reference's θ
and training state into the port's. The npz checkpoint io lands with a
later slice."""
