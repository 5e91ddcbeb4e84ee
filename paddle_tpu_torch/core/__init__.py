"""IR, op registry, eager interpreter and executor."""
