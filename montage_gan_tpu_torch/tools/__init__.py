"""Measurement tools of the port: where the card's time goes."""
