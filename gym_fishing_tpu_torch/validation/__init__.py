"""End-to-end validation runs of the port on the card (``python -m ...``)."""
