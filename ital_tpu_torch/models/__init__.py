"""The GP relevance model and the interactive session."""
