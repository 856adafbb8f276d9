"""The paper's own experiment configs (see ``models/paper_nets.py``) — a
copy of the JAX package's ``configs/paper_models.py``, which the port may
not import."""
PAPER_MODELS = {
    "2nn": dict(d_in=784, d_hidden=200, n_classes=10),          # 199,210 p
    "cnn": dict(in_ch=1, n_classes=10, img=28),                 # 1,663,370 p
    "charlstm": dict(vocab=90, d_embed=8, d_h=256),             # 820,522 p
    "miniresnet": dict(in_ch=3, width=8, n_classes=10, blocks=2),
}
