"""Evaluation and weight conversion."""
