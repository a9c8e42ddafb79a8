"""Model code of the port: configs, layers, attention, FFN, blocks, the
decoder-only LM and the family registry."""
