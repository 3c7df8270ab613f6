from .orm import Column, Model, Session, ScopedSession, MODELS

__all__ = ['Column', 'Model', 'Session', 'ScopedSession', 'MODELS']
