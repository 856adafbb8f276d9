"""The paper's models, PyTorch port (the 2NN so far)."""
