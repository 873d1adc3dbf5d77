"""Scripting front-ends: the femmcli-compatible Lua runner."""
