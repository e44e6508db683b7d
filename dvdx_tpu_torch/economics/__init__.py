"""Economics: the security and cost analysis behind the validator's knobs."""
