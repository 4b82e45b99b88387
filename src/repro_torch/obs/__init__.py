"""Flight recorder and injectable clocks."""
