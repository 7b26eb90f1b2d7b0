"""The LM half's models: layers, attention, MoE, mamba2, RG-LRU, the
decoder-only LM, whisper and the ``Model`` facade (PyTorch twins of the
reference's ``models/``)."""
