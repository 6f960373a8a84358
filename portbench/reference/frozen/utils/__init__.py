from .errors import GuestPanic, SlashableError, UnslashableError, VerificationError
