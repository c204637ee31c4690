"""OpenAI-compatible serving on the standard library."""
