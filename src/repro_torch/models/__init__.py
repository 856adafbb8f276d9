"""The paper's models, PyTorch port: the 2NN, the CNN, the CharLSTM and
the MiniResNet (``paper_nets``)."""
