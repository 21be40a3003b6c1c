"""PNG pack decoding."""
