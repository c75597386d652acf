"""Editing geometry stage: masks, depth conditions, sheet composition."""
