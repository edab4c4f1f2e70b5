"""Multi-device training on torch.distributed (`sharding.py`)."""
