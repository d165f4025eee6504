"""Model code of the port: layers, attention, MemCom cross-attention,
blocks and the transformer (``repro/models``)."""
