"""The port's language-model stack: config, layers, attention, blocks,
Mamba2, the layer stack and the model API."""
