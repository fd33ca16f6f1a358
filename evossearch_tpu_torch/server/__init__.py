from .app import create_app
from .web import App, HTTPError, Request, Response, TestClient, jsonify, serve

__all__ = [
    "create_app",
    "App",
    "HTTPError",
    "Request",
    "Response",
    "TestClient",
    "jsonify",
    "serve",
]
