"""The ``serve`` entry point."""
