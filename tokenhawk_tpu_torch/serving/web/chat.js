// Streaming chat client: POST /generate, read SSE events, append tokens
// to the newest bot message (the role web/chat.js:21-68 plays for the
// reference's WASM build — here the model runs server-side on TPU).

const log = document.getElementById("log");
const form = document.getElementById("form");
const promptBox = document.getElementById("prompt");
const sendBtn = document.getElementById("send");

// Conversation id: every message in this tab shares KV context
// server-side (n_past continuity).  Type "[cmd] reset" to clear it,
// matching the reference chat (web/main.cpp:160-179).
const sessionId = "web-" + Math.random().toString(36).slice(2);

function addMsg(cls, text) {
  const div = document.createElement("div");
  div.className = "msg " + cls;
  div.textContent = text;
  log.appendChild(div);
  log.scrollTop = log.scrollHeight;
  return div;
}

form.addEventListener("submit", async (ev) => {
  ev.preventDefault();
  const prompt = promptBox.value.trim();
  if (!prompt) return;
  promptBox.value = "";
  sendBtn.disabled = true;
  addMsg("human", prompt);
  const botDiv = addMsg("bot", "");

  try {
    const resp = await fetch("/generate", {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ prompt: prompt, max_tokens: 256, session: sessionId }),
    });
    const reader = resp.body.getReader();
    const decoder = new TextDecoder();
    let buf = "";
    for (;;) {
      const { value, done } = await reader.read();
      if (done) break;
      buf += decoder.decode(value, { stream: true });
      let idx;
      while ((idx = buf.indexOf("\n\n")) >= 0) {
        const frame = buf.slice(0, idx);
        buf = buf.slice(idx + 2);
        const line = frame.split("\n").find((l) => l.startsWith("data: "));
        if (!line) continue;
        const payload = JSON.parse(line.slice(6));
        if (frame.startsWith("event: done")) {
          if (payload.finish_reason === "error:context_full")
            botDiv.textContent += " [context full — send \"[cmd] reset\"]";
          continue;
        }
        if (payload.token !== undefined) {
          botDiv.textContent += payload.token;
          log.scrollTop = log.scrollHeight;
        }
      }
    }
  } catch (err) {
    botDiv.textContent += " [error: " + err + "]";
  } finally {
    sendBtn.disabled = false;
    promptBox.focus();
  }
});
