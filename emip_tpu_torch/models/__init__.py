"""nn.Modules of the port (NCHW, reference module tree and key names)."""
