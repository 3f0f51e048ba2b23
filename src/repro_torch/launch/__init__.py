"""Step builders of the port (the reference's ``repro.launch``)."""
