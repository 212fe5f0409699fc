"""Multi-device training and evaluation over a ('data', 'graph') mesh of
torch.distributed ranks, one process per device (the JAX package's
`parallel/`)."""
