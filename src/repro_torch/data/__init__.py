"""The seeded synthetic training corpus."""
