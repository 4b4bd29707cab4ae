"""The port's version: it names the program store's namespace and is
recorded in every program set's manifest."""
full_version = "2.0.0-h100"
