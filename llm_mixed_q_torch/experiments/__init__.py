"""The paper's experiment drivers on the port (``emnlp/``)."""
