"""Non-RL baseline controllers: the reflex walking controller."""
