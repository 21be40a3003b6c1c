"""UNetResNet blocks, encoder and trunk; registry; flax-checkpoint bridge."""
