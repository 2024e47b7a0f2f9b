"""The model stack of the port: the ssm family (falcon-mamba) so far."""
