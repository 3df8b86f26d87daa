"""Seeding, latent sampling, summaries and naming helpers."""
