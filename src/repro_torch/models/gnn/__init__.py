"""Graph neural networks: message passing (``message``) and GIN
(``models``)."""
