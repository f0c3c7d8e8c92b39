"""Functional NN core of the port: activations, eval-mode layers, blocks,
and the fused depthwise kernel's wrapper."""
