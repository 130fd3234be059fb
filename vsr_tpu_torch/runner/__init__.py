"""The trainers."""
