"""Scene configurations (the port's ``io.scenes``)."""
